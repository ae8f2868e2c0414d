from .classifier import ClassifierConfig, ClassifierTrainer, TrainState

__all__ = ["ClassifierConfig", "ClassifierTrainer", "TrainState"]
