"""Device discovery for the port."""
