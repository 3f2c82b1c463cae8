"""Core of the port: energy model, planning closed forms, Algorithm 1,
scenario configs, failure sampling, the renewal Monte-Carlo and the policy
grid (counterparts of ``repro.core``)."""
