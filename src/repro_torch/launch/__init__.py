"""Command-line entry points of the port: ``build_index`` and ``serve``."""
