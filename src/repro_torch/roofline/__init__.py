"""The dry run's counts and the roofline over them (port of
``repro.roofline``): ``op_count`` counts a step's aten ops and kernels in
``hlo_parse``'s place, ``work`` models each kernel, ``analysis`` turns
the dry run's records into the card's roofline terms."""

from repro_torch.roofline import op_count, work  # noqa: F401
