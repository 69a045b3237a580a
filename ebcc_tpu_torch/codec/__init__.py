"""Codec configuration, container format and the torch pipeline."""
