from .transactor import DistTransactor, TxApp, TxResult, TX_LOCKED, tx_payload

__all__ = ["DistTransactor", "TxApp", "TxResult", "TX_LOCKED", "tx_payload"]
