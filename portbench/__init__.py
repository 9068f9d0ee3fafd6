"""The port's benchmark (see README.md)."""
