"""The v1 inference config (counterpart of
``deeperspeed_tpu/inference/config.py``, the reference's
``DeepSpeedInferenceConfig``).

The same keys and aliases as the JAX package: dtype, ``tensor_parallel``
(alias ``tp``), the kernel-injection switches, generation lengths
(``max_tokens`` / ``min_tokens``), checkpoint loading and ``quant``
(weight-only int8 / int4).  ``enable_cuda_graph``, ``replace_with_kernel_inject``
and the other injection keys are accepted and not acted on, as in the JAX
package.  ``moe``, ``moe_experts`` and ``moe_type`` are accepted and not
acted on, as in the JAX package: MoE is configured on the model, whose
MoE blocks serve with their evaluation capacity.
"""

from typing import Any, Dict, Optional, Union

from pydantic import Field

from ..runtime.config_utils import DeeperSpeedConfigModel


class DeepSpeedTPConfig(DeeperSpeedConfigModel):
    """The tensor-parallel block."""

    enabled: bool = True
    tp_size: int = 1
    mpu: Optional[Any] = None
    tp_group: Optional[Any] = None


class QuantizationConfig(DeeperSpeedConfigModel):
    enabled: bool = False
    bits: int = 8
    group_size: int = 64


class InferenceCheckpointConfig(DeeperSpeedConfigModel):
    checkpoint_dir: Optional[str] = None
    save_mp_checkpoint_path: Optional[str] = None
    base_dir: Optional[str] = None
    tag: Optional[str] = None


class DeeperSpeedInferenceConfig(DeeperSpeedConfigModel):
    kernel_inject: bool = Field(False, alias="replace_with_kernel_inject")
    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = Field(default_factory=DeepSpeedTPConfig,
                                               alias="tp")
    enable_cuda_graph: bool = False  # accepted; eager decode steps (ROADMAP Queue C)
    zero: Dict[str, Any] = {}
    triangular_masking: bool = True
    moe: bool = False
    moe_experts: int = 1
    moe_type: str = "standard"
    checkpoint: Optional[Union[str, InferenceCheckpointConfig]] = None
    quant: QuantizationConfig = Field(default_factory=QuantizationConfig)
    max_out_tokens: int = Field(1024, alias="max_tokens")
    min_out_tokens: int = Field(1, alias="min_tokens")
    max_batch_size: int = 1
    replace_method: str = "auto"
    injection_policy: Optional[Dict] = None
    return_tuple: bool = True
    set_empty_params: bool = False
    # generation defaults
    pad_token_id: int = 0
    eos_token_id: Optional[int] = None

    @property
    def tp_size(self) -> int:
        return self.tensor_parallel.tp_size if self.tensor_parallel.enabled else 1

    @property
    def torch_dtype(self):
        import torch

        name = str(self.dtype).replace("torch.", "")
        aliases = {"half": "float16", "fp16": "float16", "bf16": "bfloat16",
                   "float": "float32", "fp32": "float32"}
        name = aliases.get(name, name)
        if name not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"unsupported inference dtype {self.dtype!r}")
        return getattr(torch, name)
