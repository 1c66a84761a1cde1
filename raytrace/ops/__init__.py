"""Numerics core: RNG, intersection, BSDF sampling, cubemap, textures.

Pure jnp functions shared by the reference-grade jnp integrator, the
Pallas production kernels, and the differentiable pass. Formula parity
with the reference is documented per-function (file:line citations into
the reference's sources)."""
