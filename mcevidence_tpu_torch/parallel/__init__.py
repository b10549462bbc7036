from .ring import (GRID_BATCH_QUANTUM, GRID_DPAD_CLASSES,
                   sharded_grid_device_refine_evidence,
                   sharded_grid_evidence_refine)
