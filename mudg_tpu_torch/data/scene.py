"""Typed scene accessors over the processed scenario layout.

A copy of `mudg_tpu/data/scene.py` (host code): the getters of the
reference's SceneDataset / WaymoDataset (`data_process/tools/
scene_dataset.py:1-77`, `tools/waymo_dataset.py:235-481`) as a thin typed
reader over `scenario.pt` and the per-modality directories the pipeline
writes, so downstream code does not poke dicts and paths directly.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np

WAYMO_CLASSES = ("unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist")


@dataclass
class CameraFrame:
    hw: tuple
    K: np.ndarray
    c2w: np.ndarray


class SceneReader:
    """Read-only accessors for one processed scene directory."""

    def __init__(self, scene_dir: str):
        self.scene_dir = scene_dir
        with open(os.path.join(scene_dir, "scenario.pt"), "rb") as f:
            self.scenario = pickle.load(f)
        self.observers = self.scenario["observers"]

    # -- cameras -------------------------------------------------------------

    @property
    def camera_names(self) -> list[str]:
        return [k for k, v in self.observers.items()
                if v.get("class_name") == "Camera" or k.startswith("camera")]

    def n_frames(self, observer: str = "lidar_TOP") -> int:
        return int(self.observers[observer]["n_frames"])

    def camera(self, name: str, index: int) -> CameraFrame:
        data = self.observers[name]["data"]
        h, w = (int(v) for v in data["hw"][index])
        return CameraFrame(
            hw=(h, w),
            K=np.asarray(data["intr"][index], np.float64),
            c2w=np.asarray(data["c2w"][index], np.float64),
        )

    def image_path(self, camera: str, index: int) -> str:
        return os.path.join(self.scene_dir, "images", camera, f"{index:08d}.jpg")

    def image(self, camera: str, index: int) -> np.ndarray:
        import cv2

        img = cv2.imread(self.image_path(camera, index))
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    # -- lidar ---------------------------------------------------------------

    def lidar_names(self) -> list[str]:
        return [k for k in self.observers if k.startswith("lidar")]

    def lidar_rays(self, lidar: str, index: int) -> dict:
        """rays_o/rays_d/ranges npz saved by the ETL (preprocess.py layout)."""
        path = os.path.join(self.scene_dir, "lidars", lidar, f"{index:08d}.npz")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    # -- derived modalities --------------------------------------------------

    def sparse_path(self, camera: str, index: int, virtual: int | None = None) -> str:
        if virtual is None:
            return os.path.join(self.scene_dir, "sparse", camera, f"{index:08d}.jpg")
        return os.path.join(self.scene_dir, "virtual_sparse", camera,
                            f"{index:08d}_{virtual}.jpg")

    def depth_path(self, camera: str, index: int, virtual: int | None = None) -> str:
        if virtual is None:
            return os.path.join(self.scene_dir, "depth", camera, f"{index:08d}.npy")
        return os.path.join(self.scene_dir, "virtual_depth", camera,
                            f"{index:08d}_{virtual}.npy")

    def depth(self, camera: str, index: int, virtual: int | None = None) -> np.ndarray:
        return np.load(self.depth_path(camera, index, virtual))

    # -- objects -------------------------------------------------------------

    def objects_info(self) -> list[dict]:
        path = os.path.join(self.scene_dir, "objects_info.pkl")
        with open(path, "rb") as f:
            return pickle.load(f)

    def background_cloud(self):
        from ..render.pointcloud import fetch_ply

        return fetch_ply(os.path.join(self.scene_dir, "objects", "background.ply"))
