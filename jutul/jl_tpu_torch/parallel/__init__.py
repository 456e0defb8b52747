"""parallel — graph partitioning (host numpy); see the package docstring."""
