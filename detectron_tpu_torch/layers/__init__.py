"""Proposal generation."""
