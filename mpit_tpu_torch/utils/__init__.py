"""Parameter trees, config, metrics and the completion barrier."""
