"""The port's training path: optimizer state, steps and the runner."""
