from .round import ServerState, init_server_state, make_select_fn
from .server import build_volatility

__all__ = ["ServerState", "init_server_state", "make_select_fn", "build_volatility"]
