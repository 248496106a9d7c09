"""The resumable runtime: checkpointed segment runs of the engine's
loops (:mod:`.resilient`), the subprocess supervisor (:mod:`.supervisor`)
and checkpoint-restart of a step function (:mod:`.fault_tolerance`)."""
