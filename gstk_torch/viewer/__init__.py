"""The live viewer: the stdlib HTTP viewer and the viser one (port of
``gstk_tpu/viewer``)."""
