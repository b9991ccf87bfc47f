"""Step factories, counterpart of ``repro/training``: so far the serving
steps (``steps.make_serve_step``, ``steps.make_prefill_step``)."""
