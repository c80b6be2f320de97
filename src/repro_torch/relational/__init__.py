"""Columnar relational substrate: tables, TPC-H data, benchmark queries."""
