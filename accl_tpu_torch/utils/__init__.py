"""Host utilities (counterpart: ``accl_tpu/utils/``)."""
