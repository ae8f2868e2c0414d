from .classifier import ClassifierConfig, ClassifierTrainer, TrainState
from .embedding import EmbeddingTrainer, EmbeddingTrainerConfig
from .joint_cnn import JointCNNConfig, JointCNNTrainer

__all__ = ["ClassifierConfig", "ClassifierTrainer", "TrainState",
           "EmbeddingTrainerConfig", "EmbeddingTrainer",
           "JointCNNConfig", "JointCNNTrainer"]
