"""Resilience (the counterpart of ``trlx_tpu.resilience``): the train
step's non-finite guard. Checkpoints, the watchdog, heartbeats and fault
plans are not ported yet; the trainer refuses their knobs."""
