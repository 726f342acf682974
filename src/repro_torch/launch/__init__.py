"""Command-line entry points of the port (``launch.serve_cnn``,
``launch.serve``, ``launch.train``) and the meshes (``launch.mesh``)."""
