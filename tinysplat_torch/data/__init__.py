from .synthetic import orbit_cameras, random_gaussian_cloud, synthetic_pcd

__all__ = ["orbit_cameras", "random_gaussian_cloud", "synthetic_pcd"]
