"""hydragnn_tpu_torch — the PyTorch + CUDA port of hydragnn_tpu for NVIDIA
Hopper GPUs. It imports torch and numpy only, never jax or the JAX
package. The kernels the JAX package wrote in Pallas are hand-written CUDA
here (hydragnn_tpu_torch/csrc), built with nvcc at first use."""
from .run_prediction import run_prediction
from .run_training import run_training

__all__ = ["run_prediction", "run_training"]
