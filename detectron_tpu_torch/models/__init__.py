"""Backbone, FPN, heads, the two-stage detector and the mask paste."""
