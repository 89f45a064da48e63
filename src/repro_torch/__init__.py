"""PyTorch/CUDA port of the ColD Fusion system in ``repro`` (the JAX
package, which stays the reference).  Same layout as ``repro``; imports
neither JAX nor anything of ``repro``."""
