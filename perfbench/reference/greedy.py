"""How far a served model's greedy tokens and logits lie from the reference's.

For each prompt and the tokens served after it, the reference runs once
over the prompt and every served token but the last, and reads the logits
at the positions where a token was served.  Two numbers a row:

* a token's gap is the reference's largest logit there less the logit of
  the served token: 0 for the token the reference puts first, and small
  where rounding flips a near tie; a row's is its widest over its tokens;
* a position's logit error is the root mean square of the served logits
  less the reference's, over the reference's own spread about its mean
  (both over the vocabulary); a row's is its worst over its positions.

With ``control`` both are read of the control in the program's place: the
tokens that the control's logits put first, and those logits.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from perfbench.reference import dense


def _rel_rms(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(..., V) -> (...): rms(got - ref) / rms(ref - mean(ref))."""
    spread = (ref - ref.mean(-1, keepdim=True)).pow(2).mean(-1).sqrt()
    return (got - ref).pow(2).mean(-1).sqrt() / spread


@torch.no_grad()
def compare(layers: List[dict], head: dict, cfg: dict, prompts, served,
            served_logits: Optional[torch.Tensor] = None,
            control: dense.Precision = None, block: int = 4
            ) -> Tuple[List[float], List[float]]:
    """prompts (n, P), served (n, G) long tensors, served_logits (n, G, V)
    the logits the tokens were picked from (not read with ``control``);
    returns each row's widest token gap and worst logit error."""
    P = prompts.shape[1]
    gaps, errs = [], []
    for lo in range(0, prompts.shape[0], block):
        seq = torch.cat([prompts[lo:lo + block], served[lo:lo + block, :-1]], dim=1)
        ref = dense.logits(head, dense.hidden(layers, head, seq, cfg, dense.F32)[:, P - 1:],
                           cfg, dense.F32)
        if control is None:
            tok = served[lo:lo + block]
            got = served_logits[lo:lo + block].to(ref.device, torch.float32)
        else:
            got = dense.logits(head, dense.hidden(layers, head, seq, cfg, control)[:, P - 1:],
                               cfg, control)
            tok = got.argmax(-1)
        gap = ref.amax(-1) - ref.gather(-1, tok[..., None])[..., 0]
        gaps += gap.amax(-1).tolist()
        errs += _rel_rms(got, ref).amax(-1).tolist()
    return gaps, errs
