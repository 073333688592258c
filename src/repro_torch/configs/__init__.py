"""Configuration surface of the port (see ``knobs``)."""
