"""stellar_core_tpu_torch — the stellar-core validator of stellar_core_tpu,
ported to PyTorch and CUDA on an NVIDIA card (written for the H100, sm_90a).

A replicated state machine maintaining a cryptographic ledger in consensus
with peers. The node logic (consensus, ledger, overlay, storage) is
deterministic, single-logical-thread Python plus host C++ helpers, copied
module by module from stellar_core_tpu. The one accelerated job, strict
batch Ed25519 signature verification, runs two hand-written CUDA kernels
(ops/csrc/) behind the same verify seam: `SIGNATURE_VERIFY_BACKEND =
"cuda"` (or "tpu", the value the repo's config files write) selects it,
with identical accept/reject semantics to the strict CPU path. On a CPU
tensor every kernel wrapper runs its plain PyTorch version instead.

This package imports torch and never jax, and nothing of stellar_core_tpu.

Layer map:
  util/    -> VirtualClock, Scheduler, logging, metrics, caches
  crypto/  -> keys, hashing, strkey, curve25519, verify cache
  ops/     -> CUDA kernels and their plain versions, batch verifiers
              (one card, several cards, several processes), the verify
              service, the backend supervisor, SLO watchdog, controller
  native/  -> host C++ verifier and SHA-512
  xdr/     -> XDR codec + protocol types
  db/, bucket/ -> persistence
  ledger/, tx/, invariant/, soroban/ -> ledger state machine
  scp/, herder/ -> consensus
  overlay/ -> p2p
  work/, process/, history/, catchup/ -> history & catchup
  query/   -> snapshot-consistent read serving
  main/    -> Application, Config, CommandHandler
  simulation/ -> in-process multi-node networks, LoadGenerator
"""

__version__ = "0.1.0"
