"""Command-line tools of the port (the reference package's tools/)."""
