from smd_tpu_torch.models.registry import MODEL_REGISTRY, get_model

__all__ = ["MODEL_REGISTRY", "get_model"]
