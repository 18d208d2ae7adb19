"""Data helpers of the port."""
