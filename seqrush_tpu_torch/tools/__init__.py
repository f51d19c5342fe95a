"""Command-line tools of the port that need a GPU (see each module)."""
