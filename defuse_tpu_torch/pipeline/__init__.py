"""Pipeline stages of the port."""
