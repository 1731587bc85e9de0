"""Resilience in the user process: the fault plan's checkpoint, input and
step faults (``faults.py``). The orchestrator's halves (failure
classification, retry policy, the coordinator's and executors' faults) run
in the orchestrator, which needs no port."""
