"""admmnet_tpu: joint delay-Doppler atomic-norm recovery framework (JAX, GPU).

A from-scratch JAX/XLA re-design of the capabilities of the
reference repo E-J408/admm-net (OFDM-ISAC joint delay-Doppler target
estimation):

- ``ops``      -- math/signal primitives (atoms, PSK, AWGN, projections)
- ``solver``   -- batched classical ANM-DUMV ADMM (lax.while_loop, masked
                  convergence), replacing the reference's per-iteration
                  ECOS/cvxpy solve with an exact vectorized projection
- ``peaks``    -- batched coarse-to-fine 2-D spectral peak search + scoring
- ``models``   -- unrolled ADMM-Net (flax) with learned per-layer parameters
- ``data``     -- pure-JAX synthetic OFDM-ISAC dataset generation + the
                  bundled ``data.npz`` anchor case
- ``train``    -- optax training drivers (losses, schedules,
                  checkpoint/resume, metrics)
- ``parallel`` -- mesh/sharding utilities (scenario/data parallelism)
- ``bench``    -- throughput/scaling benchmark harness
- ``utils``    -- compile cache, profiling and debug helpers
- ``cli``      -- entry points mirroring the reference's scripts

Everything batches over an instance axis first: the problem per instance is
tiny (MN=100, lifted matrices 101x101), so throughput comes from running
thousands of independent instances as one program sharded over a device
mesh.
"""

__version__ = "0.1.0"
