"""The LM stack's serving path (the port of `repro/archs`, dense family):
layers, the decoder model with prefill and decode, parameter specs and
synthetic batches."""
from repro_torch.archs.frontends import make_batch
from repro_torch.archs.transformer import (Model, build_model, layer_pattern,
                                           param_specs)

__all__ = ["Model", "build_model", "layer_pattern", "param_specs",
           "make_batch"]
