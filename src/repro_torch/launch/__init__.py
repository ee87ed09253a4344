"""Entry points of the port: ``launch.serve``, the serving CLI."""
