"""multimodel — see the package docstring."""
