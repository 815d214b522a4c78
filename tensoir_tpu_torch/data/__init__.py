"""Dataset registry (mirrors tensoir_tpu.data)."""
from __future__ import annotations


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
    if name == "tensoIR_relighting_test":
        from tensoir_tpu_torch.data.relight_test import (
            TensoIRRelightingTestDataset)
        return TensoIRRelightingTestDataset
    if name == "tensoIR_material_editing_test":
        from tensoir_tpu_torch.data.relight_test import (
            TensoIRMaterialEditingTestDataset)
        return TensoIRMaterialEditingTestDataset
    if name == "synthetic_sphere":
        from tensoir_tpu_torch.data.synthetic import SyntheticSphereDataset
        return SyntheticSphereDataset
    raise KeyError(f"unknown dataset {name}")


dataset_dict = {name: name for name in (
    "blender", "tensoIR_simple", "tensoIR_unknown_rotated_lights",
    "tensoIR_unknown_general_multi_lights", "tensoIR_relighting_test",
    "tensoIR_material_editing_test", "synthetic_sphere")}
