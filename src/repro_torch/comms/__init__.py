"""Mix backend of the port (node-stacked on one card)."""
