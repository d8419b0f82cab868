"""Host-side utilities (the counterpart of ``trlx_tpu.utils``)."""
