"""The aligner frontend of the port."""
