from .trainer import TrainHyper, TrainState, Trainer, make_train_step
from .checkpoint import CheckpointManager
from .fault_tolerance import HeartbeatJournal, StragglerPolicy
