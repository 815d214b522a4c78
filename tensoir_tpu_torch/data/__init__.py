"""Dataset registry (mirrors tensoir_tpu.data). Only the synthetic scenes
are ported; each other name raises ``NotImplementedError`` naming the
ROADMAP item that ports its loader."""
from __future__ import annotations

# the file loaders need PNG and RGBE readers of their own (ROADMAP queue 1
# item 5); the relighting test sets also need relighting (item 6)
_NOT_PORTED = {
    "blender": "item 5 (file loaders)",
    "tensoIR_simple": "item 5 (file loaders)",
    "tensoIR_unknown_rotated_lights": "item 5 (file loaders)",
    "tensoIR_unknown_general_multi_lights": "item 5 (file loaders)",
    "tensoIR_relighting_test": "items 5 and 6 (file loaders, relighting)",
    "tensoIR_material_editing_test":
        "items 5 and 6 (file loaders, relighting)",
}


def get_dataset(name: str):
    """The dataset class registered under ``name``."""
    if name == "synthetic_sphere":
        from tensoir_tpu_torch.data.synthetic import SyntheticSphereDataset
        return SyntheticSphereDataset
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r}: its loader is not ported yet (ROADMAP "
            f"queue 1 {_NOT_PORTED[name]})")
    raise KeyError(f"unknown dataset {name}")


dataset_dict = {name: name for name in (*_NOT_PORTED, "synthetic_sphere")}
