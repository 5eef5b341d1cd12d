"""Model registry (port of ``pd_fusion/experiments/registry.py``):
model_type string -> constructor path. ``cli`` checks ``--model`` against
it, so an unknown name fails with the valid list.
"""
MODEL_REGISTRY = {
    "fusion_late": "pd_fusion_torch.models.fusion_late:LateFusionModel",
    "fusion_masked": "pd_fusion_torch.models.fusion_masked:MaskedFusionModel",
    "fusion_moddrop": "pd_fusion_torch.models.fusion_moddrop:ModalityDropoutModel",
    "moe": "pd_fusion_torch.models.moe:MoEModel",
    "unimodal_gbdt": "pd_fusion_torch.models.unimodal_gbdt:UnimodalGBDT",
    "unimodal_mlp": "pd_fusion_torch.models.fusion_late:LateFusionModel",
    "mil_attention": "pd_fusion_torch.models.mil_attention:MilAttentionModel",
    "mil_attention_ft": "pd_fusion_torch.models.mil_attention_finetune:MilAttentionFineTuneModel",
    "constant": "pd_fusion_torch.models.dummy:ConstantProbabilityModel",
}
