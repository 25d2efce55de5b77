"""Training of the port (``loop``): one device, pp = 1."""
