from .benchmark import benchmark
from .test import test
from .train_or_resume import train

__all__ = ['benchmark', 'test', 'train']
