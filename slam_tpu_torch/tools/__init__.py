"""Command-line measurements of the port, each the counterpart of a script
of the repo's `tools/`."""
