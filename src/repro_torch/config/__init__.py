"""Component registry and graph resolver of the port."""
