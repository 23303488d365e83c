"""Batched inference pipeline of the port."""
