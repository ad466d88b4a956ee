from .repartition import coarse_repartition_perm

__all__ = ["coarse_repartition_perm"]
