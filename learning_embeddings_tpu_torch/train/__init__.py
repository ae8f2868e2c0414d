from .classifier import ClassifierConfig, ClassifierTrainer, TrainState
from .embedding import EmbeddingTrainer, EmbeddingTrainerConfig
from .joint import JointEmbeddingTrainer, JointTrainerConfig
from .joint_cnn import JointCNNConfig, JointCNNTrainer

__all__ = ["ClassifierConfig", "ClassifierTrainer", "TrainState",
           "EmbeddingTrainerConfig", "EmbeddingTrainer",
           "JointTrainerConfig", "JointEmbeddingTrainer",
           "JointCNNConfig", "JointCNNTrainer"]
