from .benchmark import benchmark
from .test import test
from .train_or_resume import train_or_resume

__all__ = ['benchmark', 'test', 'train_or_resume']
