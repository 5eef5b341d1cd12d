"""Model registry (port of ``pd_fusion/experiments/registry.py``):
model_type string -> constructor path. ``cli`` checks ``--model`` against
it, so an unknown name fails with the valid list. The families in
``NOT_PORTED`` are named by the JAX package but raise
``NotImplementedError`` here, with the ROADMAP item that brings them.
"""
MODEL_REGISTRY = {
    "fusion_late": "pd_fusion_torch.models.fusion_late:LateFusionModel",
    "fusion_masked": "pd_fusion_torch.models.fusion_masked:MaskedFusionModel",
    "fusion_moddrop": "pd_fusion_torch.models.fusion_moddrop:ModalityDropoutModel",
    "moe": None,
    "unimodal_gbdt": None,
    "unimodal_mlp": "pd_fusion_torch.models.fusion_late:LateFusionModel",
    "mil_attention": "pd_fusion_torch.models.mil_attention:MilAttentionModel",
    "mil_attention_ft": None,
    "constant": "pd_fusion_torch.models.dummy:ConstantProbabilityModel",
}

NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 8",
    "unimodal_gbdt": "ROADMAP Queue 1 item 12",
    "mil_attention_ft": "ROADMAP Queue 1 item 11",
}


def check_ported(model_type: str):
    """Raise ``NotImplementedError`` for a family the port does not have yet."""
    if model_type in NOT_PORTED:
        raise NotImplementedError(
            f"model_type '{model_type}' is not ported to pd_fusion_torch yet "
            f"({NOT_PORTED[model_type]})"
        )
