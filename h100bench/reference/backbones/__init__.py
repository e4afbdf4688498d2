"""The reference's backbones, one file each, found by a configuration's
``reference.backbone`` name. Each file defines ``build(spec) -> (module,
channels of its output levels)``."""
