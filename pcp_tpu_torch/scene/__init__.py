"""Scene loading: COLMAP and Blender (NeRF-synthetic) datasets -> camera
lists + point clouds (counterpart of ``pcp_tpu/scene/__init__.py``). The
reference's Scene / PartitionScene / Scene_Eval wrappers are in
``scene.wrappers``."""

from pcp_tpu_torch.scene.dataset import (  # noqa: F401
    CameraInfo,
    SceneInfo,
    load_colmap_scene,
    nerfpp_extent,
    split_train_test,
)
from pcp_tpu_torch.scene.blender import (  # noqa: F401
    is_blender_scene,
    load_blender_scene,
)

# sceneLoadTypeCallbacks parity (dataset_readers.py:525-531)
scene_load_callbacks = {
    "Colmap": load_colmap_scene,
    "Blender": load_blender_scene,
}


def load_scene(source_path: str, *, white_background: bool = False,
               eval_split: bool = True, images_dir: str = "images",
               man_trans=None, **kwargs):
    """Sniff the dataset type like the reference Scene.__init__
    (scene/__init__.py:40-47): transforms_train.json -> Blender, else
    COLMAP sparse/."""
    if is_blender_scene(source_path):
        return load_blender_scene(
            source_path, white_background=white_background,
            eval_split=eval_split, **kwargs,
        )
    return load_colmap_scene(
        source_path, images_dir=images_dir, man_trans=man_trans, **kwargs
    )
