"""Core of the port: energy model, planning closed forms and planners,
Algorithm 1, scenario configs and the failure-instant shift, the event
oracle and Table 4, failure sampling, the failure-time sweep and its
Monte-Carlo, the renewal engines and the policy grid (counterparts of
``repro.core``)."""
