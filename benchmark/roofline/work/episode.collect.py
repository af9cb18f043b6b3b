"""``collect_steps_philox``'s work in a Collect episode window, counted as
``chip_smoke.py`` phase 3 counts a launch (``cst_ops``), frozen here:
per env and step the moves, the two Philox calls (actions, the step's
uniforms) and the words read; per pickup its reward and, with respawn, a
masked pick; per fresh board its Philox calls and words, the board's
cells, the ball placements' picks and the agents' placements.  The
window's pickups are the checked call's (replayed by the reference) times
the traced calls; its fresh boards one an env an episode.  Bytes: per
launch the packed board, the positions and the running rewards read and
written, and the static tables (respawn rects and placement rects as bit
words, the placement program, the slot rewards)."""

from benchmark.reference import collect as ref_co
from benchmark.roofline import counts, window

KERNEL = "collect_steps_philox"
#: A masked pick over bit-packed masks: an AND, a popcount and a running
#: sum a 32-cell word, and a constant to find the chosen bit and write
#: its cell.
PICK_OPS_PER_WORD = 3
PICK_OPS = 8
#: A pickup: the slot's clamp, its reward's and info slot's reads, the
#: reward's add, the counter's range test and increment.
PICKUP_OPS = 6


def pick_ops(n_picks: int, n_cells: int) -> int:
    """Operations of ``n_picks`` masked picks over boards of ``n_cells``."""
    return n_picks * (-(-n_cells // 32) * PICK_OPS_PER_WORD + PICK_OPS)


def launch_bytes(t, B: int) -> int:
    """Bytes of one launch: the state read and written, the tables read."""
    C, A, nb, nw = t.n_cells, t.n_agents, len(t.ball_colors), -(-t.n_cells // 32)
    tables = 4 * (len(t.rects) * nw + (nb + 1) * nw + nb + 2 * A + len(t.slot_rewards))
    return 2 * B * 4 * (C + 2 * A + A) + tables


def read(run):
    seconds = window.matched(run, "collect::", "steps_philox_kernel")
    pickups = run.counts.get("pickups")
    if seconds is None or pickups is None:
        return None
    c, t, calls = run.counts, ref_co.tables(run.cell.config["config"]), run.trace.calls
    B, C, A, n_u = c["num_envs"], t.n_cells, t.n_agents, t.n_uniforms
    launches = -(-c["steps_per_call"] // c["chunk"]) * calls
    ops = (c["steps_per_call"] * calls * B
           * (A * counts.MOVE_OPS + 2 * counts.PHILOX_CALL_OPS + (A + 3) * counts.PHILOX_WORD_OPS)
           + pickups * calls * (PICKUP_OPS + (pick_ops(1, C) if t.respawn else 0))
           + c["episodes"] * (-(-n_u // 4) * counts.PHILOX_CALL_OPS + n_u * counts.PHILOX_WORD_OPS
                              + C + pick_ops(len(t.ball_colors), C) + A * counts.MOVE_OPS))
    return launches * launch_bytes(t, B), ops, seconds
