"""Proposal generation and the training targets."""
