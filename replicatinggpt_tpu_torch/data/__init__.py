"""Corpus, train/val split and batchers of the port's training path."""
