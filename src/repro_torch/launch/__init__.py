"""Entry points of the port: ``launch.serve``, the serving CLI, and
``launch.train``, the training CLI."""
