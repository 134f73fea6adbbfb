"""Wavefront stages: raygen, traversal, sort, shading, tonemap."""
