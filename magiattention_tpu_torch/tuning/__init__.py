"""Kernel-choice helpers: for now only the mask-shape part of the JAX
package's cost model (``cost_model.exact_mask_area`` and the density
threshold below which a mask takes the compact sparse grid)."""

from .cost_model import SPARSE_DENSITY_THRESHOLD, exact_mask_area, mask_density

__all__ = ["SPARSE_DENSITY_THRESHOLD", "exact_mask_area", "mask_density"]
