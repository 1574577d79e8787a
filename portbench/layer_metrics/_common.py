"""The arithmetic the readers share."""

from .. import roofline
from ..trace import kernel_seconds

# Kernel names of the program's hand-written kernels, as the profiler shows them.
K1 = (r'\bfused_tail_fwd_kernel\b', r'\bfwd_sum_kernel\b', r'\bfused_tail_bwd_kernel\b',
      r'\bbwd_sum_kernel\b')
K3 = (r'\beval_tail_kernel\b', r'\bsum_partials_kernel\b')


def idle_pct(obs):
    t = obs['trace']
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])


def step_mfu(obs):
    """The model FLOPs of the steps in the untraced window over its seconds,
    as a share of the card's dense bfloat16 peak."""
    tr = obs['traffic']
    train = tr['driver'] == 'train'
    flops = roofline.model_flops(obs['cfg'], tr.get('batch', 1), train)
    return 100.0 * flops * obs['steps'] / obs['window_s'] / roofline.STEP_PEAK_OPS_PER_S


def _bf16(obs):
    return obs['cfg']['compute_dtype'] == 'bfloat16'


def k1_roofline(obs):
    secs, n = kernel_seconds(obs['trace'], K1)
    if not n:
        return None
    cfg, b = obs['cfg'], obs['traffic']['batch']
    bound = roofline.k1_bound_s(b, cfg['output_hw'], cfg['num_classes'], _bf16(obs))
    return 100.0 * bound * obs['trace']['steps'] / secs


def k3_roofline(obs):
    secs, n = kernel_seconds(obs['trace'], K3)
    if not n:
        return None
    cfg, b = obs['cfg'], obs['traffic']['batch']
    bound = roofline.k3_bound_s(b, cfg['output_hw'], cfg['num_classes'], _bf16(obs))
    return 100.0 * bound * obs['trace']['steps'] / secs
