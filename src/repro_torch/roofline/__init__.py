"""The measurement layer: the H100's peaks and the roofline
(``roofline/model.py``), and what a call of the program counts
(``roofline/counts.py``)."""
from repro_torch.roofline.counts import StepCosts, step_costs
from repro_torch.roofline.model import (HW, Cost, RooflineTerms, achieved_fraction,
                                        analytic_flops_per_token, kernel_roofline,
                                        model_flops, roofline_from_costs)

__all__ = ["HW", "Cost", "RooflineTerms", "StepCosts", "achieved_fraction",
           "analytic_flops_per_token", "kernel_roofline", "model_flops",
           "roofline_from_costs", "step_costs"]
