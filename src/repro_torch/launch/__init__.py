"""Command-line entry points of the port (``launch.serve_cnn``)."""
