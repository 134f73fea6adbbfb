"""The two-phase per-lane treelet traversal (counterpart of
``experiments/treelet/``): ``build.py`` cuts the BVH2 into a top table and
1024-entry subtrees; ``lane_top.py`` (E6) collects each ray's subtrees
and lays the (subtree, ray) pairs out; ``regroup.py`` (K4 through
``ops/slab_sort.py``, then E5) groups the pairs by subtree;
``lane_bottom.py`` (E7) walks them; ``pipeline.py`` ties the phases
together with a fallback to the non-treelet traversal. Opt in with
``build_scene_buffers(scene, treelets=True)``: ``intersect_any`` then
sends every closest-hit wave through ``treelet_intersect``.
"""

from .build import TreeletDevice, build_treelet_device, build_treelets
from .pipeline import treelet_intersect, treelet_occluded

__all__ = ["TreeletDevice", "build_treelet_device", "build_treelets",
           "treelet_intersect", "treelet_occluded"]
