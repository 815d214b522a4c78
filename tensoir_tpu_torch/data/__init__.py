"""Dataset registry (mirrors tensoir_tpu.data). The relighting and
material-editing test sets raise ``NotImplementedError`` naming the ROADMAP
item that ports them."""
from __future__ import annotations

# the test sets of relighting need relighting (ROADMAP queue 1 item 6b)
_NOT_PORTED = {
    "tensoIR_relighting_test": "item 6b (relighting)",
    "tensoIR_material_editing_test": "item 6b (relighting)",
}


def get_dataset(name: str):
    """The dataset class registered under ``name``."""
    if name == "blender":
        from tensoir_tpu_torch.data.blender import BlenderDataset
        return BlenderDataset
    if name == "tensoIR_simple":
        from tensoir_tpu_torch.data.tensoir import TensoIRSimpleDataset
        return TensoIRSimpleDataset
    if name == "tensoIR_unknown_rotated_lights":
        from tensoir_tpu_torch.data.tensoir import TensoIRRotatedLightsDataset
        return TensoIRRotatedLightsDataset
    if name == "tensoIR_unknown_general_multi_lights":
        from tensoir_tpu_torch.data.tensoir import (
            TensoIRGeneralMultiLightsDataset)
        return TensoIRGeneralMultiLightsDataset
    if name == "synthetic_sphere":
        from tensoir_tpu_torch.data.synthetic import SyntheticSphereDataset
        return SyntheticSphereDataset
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r}: its loader is not ported yet (ROADMAP "
            f"queue 1 {_NOT_PORTED[name]})")
    raise KeyError(f"unknown dataset {name}")


dataset_dict = {name: name for name in (
    "blender", "tensoIR_simple", "tensoIR_unknown_rotated_lights",
    "tensoIR_unknown_general_multi_lights", *_NOT_PORTED, "synthetic_sphere")}
