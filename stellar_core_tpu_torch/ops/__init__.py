"""Device path: field, SHA-512, prep and ladder kernels, verifier."""
