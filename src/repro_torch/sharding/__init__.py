"""Sharding plans and the pipeline schedule's telemetry (port of
``repro.sharding``): :mod:`.plans` lays each param leaf out as a DTensor on
a ``DeviceMesh`` whose dim names are JAX's axis names; :mod:`.pipeline`
holds the microbatch and bubble arithmetic that ``plans.pipeline_info``
reports."""
