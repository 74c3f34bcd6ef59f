from .grow import FeatureMeta, GrowParams, TreeArrays, grow_tree_impl
from .wave import grow_tree_wave_impl

__all__ = ["FeatureMeta", "GrowParams", "TreeArrays", "grow_tree_impl",
           "grow_tree_wave_impl"]
