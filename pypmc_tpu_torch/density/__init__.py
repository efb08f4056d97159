"""Probability densities: Gaussian/Student-t components, mixtures, and the
stacked-parameter functional core."""

from . import base, core, gauss, mixture, student_t
from ._partition import partition, patch_data
from .base import LocalDensity, ProbabilityDensity
from .gauss import Gauss, LocalGauss
from .mixture import (
    MixtureDensity,
    create_gaussian_mixture,
    create_t_mixture,
    recover_gaussian_mixture,
    recover_t_mixture,
)
from .student_t import LocalStudentT, StudentT
