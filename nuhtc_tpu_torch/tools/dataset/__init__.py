"""Dataset command lines of the port (``convert_format``)."""
