from .classifier import ClassifierConfig, ClassifierTrainer, TrainState
from .joint_cnn import JointCNNConfig, JointCNNTrainer

__all__ = ["ClassifierConfig", "ClassifierTrainer", "TrainState",
           "JointCNNConfig", "JointCNNTrainer"]
