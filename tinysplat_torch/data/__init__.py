from .blender import BlenderDataset
from .colmap import load_reconstruction
from .dataset import Dataset
from .synthetic import orbit_cameras, random_gaussian_cloud, synthetic_pcd

__all__ = [
    "BlenderDataset",
    "Dataset",
    "load_reconstruction",
    "orbit_cameras",
    "random_gaussian_cloud",
    "synthetic_pcd",
]
