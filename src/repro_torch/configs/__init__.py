"""Model configurations of the port (MF only in this slice)."""
