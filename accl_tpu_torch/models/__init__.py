"""Model families built on the port's collectives (counterpart:
``accl_tpu/models/``)."""
