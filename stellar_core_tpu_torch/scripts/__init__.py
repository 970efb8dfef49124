"""The operator and developer tools that drive the package, each run as
`python -m stellar_core_tpu_torch.scripts.<name>`:

- analyze: the determinism, thread-domain and registry analyzer
  (analysis/) over the package;
- native_sanitize: the native tests under ASan+UBSan;
- profile_catchup: publish a synthetic archive, replay it under cProfile;
- cuda_differential: the kernels on the card against their plain
  versions on the CPU and the oracle, over 10k+ signatures;
- chaos_soak: seeded chaos (or Byzantine) scenario rounds, one verdict;
- replay_report: the first divergence of two replay traces;
- soroban_settings_upgrade: propose a Soroban CONFIG upgrade through a
  node's admin API.
"""
