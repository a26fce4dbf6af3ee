"""Backbone, FPN, heads and the two-stage detector."""
