"""Samplers: importance sampling and (adaptive) Markov chains."""

from ._target import (
    batched_target,
    evaluate_target,
    evaluate_target_T,
    is_batched,
    is_transposed,
)
from .importance_sampling import (
    ImportanceSampler,
    calculate_covariance,
    calculate_expectation,
    calculate_mean,
    combine_weights,
)
from .markov_chain import AdaptiveMarkovChain, MarkovChain, sample_adaptive_chains
