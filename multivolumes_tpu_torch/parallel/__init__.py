"""Multi-device scaling: the device mesh, the sharded frame step and the
collectives it moves data through."""
