"""Model zoo substrate: the dense, audio, vlm, ssm and hybrid families behind
one Model API."""

from .model import Model, build_model
from .param import (ParamSpec, abstract, count_params, from_numpy_tree,
                    materialize, named_leaves, param_bytes)

__all__ = ["Model", "ParamSpec", "abstract", "build_model", "count_params",
           "from_numpy_tree", "materialize", "named_leaves", "param_bytes"]
