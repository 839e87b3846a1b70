"""The port's side of each model family: its configuration built from the
configuration file and its training step, driven through
the port's own entry points. ``families/<family>.py`` beside
``reference/<family>.py``."""
