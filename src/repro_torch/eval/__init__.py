"""The referee LM judge, the multi-agent debate protocol and the metrics of
the cache's hit decisions."""
from .judge import make_loglik_scorer, PERSONAS, persona_score
from .debate import run_debate, debate_batch, verdict_shares, DebateResult
from .metrics import precision_recall, pr_curve
