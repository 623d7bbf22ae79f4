"""Host-side helpers of the trainer (counterpart of `m3p_tpu/utils/`)."""
