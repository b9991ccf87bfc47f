"""The ten architectures of the reference's registry, counterpart of
``repro/configs``: each module's ``CONFIG`` holds the published dims and
``smoke_config()`` a reduced config of the same family."""
