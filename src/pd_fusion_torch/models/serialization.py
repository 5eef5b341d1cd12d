"""Model artifact loading (port of ``pd_fusion/models/serialization.py``).

Every MLP-, MoE- or MIL-family model saves a dict artifact tagged with
``kind`` and numpy params; the GBDT and host-side models (constant,
calibrated, conformal) pickle whole objects. ``load_model`` dispatches on whatever it finds,
which is what the ``evaluate`` subcommand runs on.
"""
import importlib

from pd_fusion_torch.utils.io import load_pickle

_KIND_LOADERS = {
    "fusion_late": ("pd_fusion_torch.models.fusion_late", "LateFusionModel"),
    "fusion_masked": ("pd_fusion_torch.models.fusion_masked", "MaskedFusionModel"),
    "fusion_moddrop": ("pd_fusion_torch.models.fusion_moddrop", "ModalityDropoutModel"),
    "moe": ("pd_fusion_torch.models.moe", "MoEModel"),
    "mil_attention": ("pd_fusion_torch.models.mil_attention", "MilAttentionModel"),
    "mil_attention_ft": ("pd_fusion_torch.models.mil_attention_finetune",
                         "MilAttentionFineTuneModel"),
}


def load_model(path):
    """Load any model artifact the port or the JAX package produced."""
    obj = load_pickle(path)
    if isinstance(obj, dict) and "kind" in obj:
        kind = obj["kind"]
        if kind not in _KIND_LOADERS:
            raise ValueError(f"Unknown model artifact kind: {kind}")
        module_name, cls_name = _KIND_LOADERS[kind]
        cls = getattr(importlib.import_module(module_name), cls_name)
        return cls.load(path)
    # whole-object pickles (UnimodalGBDT, ConstantProbabilityModel,
    # CalibratedModel, MaskConformalWrapper) deserialize directly
    return obj
