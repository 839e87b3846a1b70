"""Ops of the port: attention (plain reference + the Hopper flash kernel)."""
