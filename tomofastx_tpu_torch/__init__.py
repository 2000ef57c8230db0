"""tomofastx_tpu_torch — the PyTorch/CUDA port of the 3-D potential-field
(gravity + magnetics) joint inversion framework.

The package mirrors the layout of the JAX package beside it, module by
module, and shares no code with it. Tensor code is plain PyTorch; the
tile-union sensitivity product is a CUDA kernel written for Hopper
(``csrc/tile_matvec.cu``, bound in ``ops/tile_matvec.py``). Every entry
point takes an explicit ``device`` and runs on ``cuda`` unless the caller
asks for the CPU.

Subpackages
-----------
- ``config``    : Parfile-compatible configuration (reference: parameters_init.f90)
- ``models``    : grid / model / survey-data containers
- ``ops``       : numerical kernels (prism integrals, wavelets, LSQR, tile product)
- ``inversion`` : constraint operators, joint inversion, workflow orchestration
- ``io``        : readers/writers for the reference's ASCII/VTK/binary formats
- ``utils``     : memory report, noise
"""

__version__ = "0.1.0"

from tomofastx_tpu_torch.config.parfile import read_parfile, Config  # noqa: F401
