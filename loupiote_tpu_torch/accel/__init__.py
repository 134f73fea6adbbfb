"""Host-side acceleration structures: BVH2 build and wide collapse."""
