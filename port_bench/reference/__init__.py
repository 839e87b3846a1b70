"""Plain PyTorch references, in f32 with TF32 off: no kernel, cache or
batching of the port, and no import of it. ``reference/<family>.py`` holds a
family's parameter layout and loss."""
