from pathtracer.accel.build import build_accel, morton_order
from pathtracer.accel.cluster import ClusterAccel, build_cluster_accel

__all__ = [
    "build_accel",
    "morton_order",
    "ClusterAccel",
    "build_cluster_accel",
]
