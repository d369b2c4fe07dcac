"""Launch entry points of the port: serving (``launch.serve``) and
training (``launch.train``)."""
