"""Launch drivers of the port (``repro.launch``)."""
