"""TPC-DS mini-kit: generators + the reporting-family queries.

The port's copy of snappydata_tpu/utils/tpcds.py: the same generators on
the same RNG streams (equal seeds give bit-identical arrays in both
packages), the same `table_sizes`, `load_tpcds` and query text.  The
star-schema tables generate synthetically at a scale factor,
FK-consistent, with the canonical column names so the canonical query
text runs verbatim (after the TPC-DS harness of the system this repo
models, which drives dsdgen output through a session).

Queries included: the brand/category revenue reporting family
(q3, q42, q52, q55), the 6-way join q19, the correlated-subquery
customer report q6, the ROLLUP gross-margin report q36, and the
windowed revenue-ratio report q98.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

STORE_SALES_ROWS_PER_SF = 2_880_000


def gen_date_dim(num_years: int = 5, seed: int = 0) -> Dict[str, np.ndarray]:
    days = 365 * num_years
    sk = np.arange(2_450_000, 2_450_000 + days, dtype=np.int64)
    doy = np.arange(days) % 365
    year = 1998 + (np.arange(days) // 365)
    moy = (doy // 30) % 12 + 1
    return {
        "d_date_sk": sk,
        "d_year": year.astype(np.int32),
        "d_moy": moy.astype(np.int32),
        "d_qoy": ((moy - 1) // 3 + 1).astype(np.int32),
        "d_dow": (np.arange(days) % 7).astype(np.int32),
    }


def gen_item(n: int, seed: int = 1) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    sk = np.arange(1, n + 1, dtype=np.int64)
    brand_id = rng.integers(1, 1000, n).astype(np.int32)
    cat_id = rng.integers(1, 11, n).astype(np.int32)
    manufact = rng.integers(1, 200, n).astype(np.int32)
    manager = rng.integers(1, 100, n).astype(np.int32)
    price = np.round(rng.uniform(1, 100, n), 2)
    # drawn AFTER the original columns so their RNG stream (and the
    # canonical queries' point predicates) is unchanged
    cls_id = rng.integers(1, 17, n).astype(np.int32)
    return {
        "i_item_sk": sk,
        "i_brand_id": brand_id,
        "i_brand": np.array([f"brand#{b}" for b in brand_id],
                            dtype=object),
        "i_category_id": cat_id,
        "i_category": np.array([f"cat#{c}" for c in cat_id], dtype=object),
        "i_class_id": cls_id,
        "i_class": np.array([f"class#{c}" for c in cls_id], dtype=object),
        "i_manufact_id": manufact,
        "i_manager_id": manager,
        "i_current_price": price,
    }


def gen_customer(n: int, n_addr: int, seed: int = 2):
    rng = np.random.default_rng(seed)
    return {
        "c_customer_sk": np.arange(1, n + 1, dtype=np.int64),
        "c_current_addr_sk": rng.integers(1, n_addr + 1,
                                          n).astype(np.int64),
        "c_birth_month": rng.integers(1, 13, n).astype(np.int32),
    }


def gen_customer_address(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return {
        "ca_address_sk": np.arange(1, n + 1, dtype=np.int64),
        "ca_gmt_offset": rng.choice([-8.0, -7.0, -6.0, -5.0], n),
        "ca_state": np.array(["CA", "TX", "NY", "WA"],
                             dtype=object)[rng.integers(0, 4, n)],
    }


def gen_store(n: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    return {
        "s_store_sk": np.arange(1, n + 1, dtype=np.int64),
        "s_gmt_offset": rng.choice([-8.0, -7.0, -6.0, -5.0], n),
        "s_state": np.array(["CA", "TX", "NY", "WA"],
                            dtype=object)[rng.integers(0, 4, n)],
    }


def gen_store_sales(n: int, n_dates: int, n_items: int, n_cust: int,
                    n_stores: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    return {
        "ss_sold_date_sk": (2_450_000 + rng.integers(
            0, n_dates, n)).astype(np.int64),
        "ss_item_sk": rng.integers(1, n_items + 1, n).astype(np.int64),
        "ss_customer_sk": rng.integers(1, n_cust + 1, n).astype(np.int64),
        "ss_store_sk": rng.integers(1, n_stores + 1, n).astype(np.int64),
        "ss_quantity": rng.integers(1, 100, n).astype(np.int32),
        "ss_ext_sales_price": np.round(rng.uniform(1, 2000, n), 2),
        "ss_sales_price": np.round(rng.uniform(1, 200, n), 2),
        "ss_net_profit": np.round(rng.uniform(-200, 2000, n), 2),
        "ss_coupon_amt": np.round(rng.uniform(0, 50, n), 2),
        "ss_list_price": np.round(rng.uniform(1, 250, n), 2),
    }


def table_sizes(sf: float) -> Dict[str, int]:
    """Row counts per scale factor — the single sizing source for both
    the loader and test oracles."""
    return {
        "store_sales": max(2000, int(STORE_SALES_ROWS_PER_SF * sf)),
        "item": max(100, int(18_000 * sf)),
        "customer": max(200, int(100_000 * sf)),
        "customer_address": max(100, int(50_000 * sf)),
        "store": max(4, int(12 * max(sf, 1.0))),
    }


def load_tpcds(session, sf: float = 0.001, seed: int = 0,
               partition_sales: bool = False) -> None:
    """Create + populate the TPC-DS star schema at the scale factor."""
    sizes = table_sizes(sf)
    n_ss = sizes["store_sales"]
    n_item = sizes["item"]
    n_cust = sizes["customer"]
    n_addr = sizes["customer_address"]
    n_store = sizes["store"]
    dd = gen_date_dim(seed=seed)
    n_dates = len(dd["d_date_sk"])

    opts = " OPTIONS (partition_by 'ss_item_sk')" if partition_sales \
        else ""
    session.sql(
        "CREATE TABLE store_sales (ss_sold_date_sk BIGINT, "
        "ss_item_sk BIGINT, ss_customer_sk BIGINT, ss_store_sk BIGINT, "
        "ss_quantity INT, ss_ext_sales_price DOUBLE, "
        "ss_sales_price DOUBLE, ss_net_profit DOUBLE, "
        "ss_coupon_amt DOUBLE, ss_list_price DOUBLE) USING column"
        + opts)
    session.sql("CREATE TABLE date_dim (d_date_sk BIGINT, d_year INT, "
                "d_moy INT, d_qoy INT, d_dow INT) USING column")
    session.sql("CREATE TABLE item (i_item_sk BIGINT, i_brand_id INT, "
                "i_brand STRING, i_category_id INT, i_category STRING, "
                "i_class_id INT, i_class STRING, "
                "i_manufact_id INT, i_manager_id INT, "
                "i_current_price DOUBLE) USING column")
    session.sql("CREATE TABLE customer (c_customer_sk BIGINT, "
                "c_current_addr_sk BIGINT, c_birth_month INT) "
                "USING column")
    session.sql("CREATE TABLE customer_address (ca_address_sk BIGINT, "
                "ca_gmt_offset DOUBLE, ca_state STRING) USING column")
    session.sql("CREATE TABLE store (s_store_sk BIGINT, "
                "s_gmt_offset DOUBLE, s_state STRING) USING column")

    session.insert_arrays("date_dim", list(dd.values()))
    session.insert_arrays("item",
                          list(gen_item(n_item, seed + 1).values()))
    session.insert_arrays(
        "customer", list(gen_customer(n_cust, n_addr,
                                      seed + 2).values()))
    session.insert_arrays(
        "customer_address",
        list(gen_customer_address(n_addr, seed + 3).values()))
    session.insert_arrays("store",
                          list(gen_store(n_store, seed + 4).values()))
    session.insert_arrays(
        "store_sales",
        list(gen_store_sales(n_ss, n_dates, n_item, n_cust, n_store,
                             seed + 5).values()))


Q3 = """SELECT d_year, i_brand_id, i_brand,
    sum(ss_ext_sales_price) AS sum_agg
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manufact_id = 100 AND d_moy = 11
GROUP BY d_year, i_brand_id, i_brand
ORDER BY d_year, sum_agg DESC, i_brand_id LIMIT 100"""

Q42 = """SELECT d_year, i_category_id, i_category,
    sum(ss_ext_sales_price) AS total
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id = 1 AND d_moy = 11 AND d_year = 2000
GROUP BY d_year, i_category_id, i_category
ORDER BY total DESC, d_year, i_category_id, i_category LIMIT 100"""

Q52 = """SELECT d_year, i_brand_id, i_brand,
    sum(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id = 1 AND d_moy = 11 AND d_year = 2000
GROUP BY d_year, i_brand_id, i_brand
ORDER BY d_year, ext_price DESC, i_brand_id LIMIT 100"""

Q55 = """SELECT i_brand_id, i_brand,
    sum(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id = 28 AND d_moy = 11 AND d_year = 1999
GROUP BY i_brand_id, i_brand
ORDER BY ext_price DESC, i_brand_id LIMIT 100"""

# q19's point predicates (manager = 8, one month of one year) select
# ~1 row against the synthetic distributions at test scale; the manager
# range keeps the 6-way join shape while returning a result set
Q19 = """SELECT i_brand_id, i_brand, i_manufact_id,
    sum(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item, customer, customer_address, store
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id BETWEEN 8 AND 40 AND d_moy = 11
  AND ss_customer_sk = c_customer_sk
  AND c_current_addr_sk = ca_address_sk
  AND ss_store_sk = s_store_sk AND ca_state <> s_state
GROUP BY i_brand_id, i_brand, i_manufact_id
ORDER BY ext_price DESC, i_brand_id LIMIT 100"""

# q6: state-level count of customers buying items priced over 1.2x
# their category average — CORRELATED scalar-aggregate subquery +
# HAVING (month predicates widened to return rows at test scale)
Q6 = """SELECT a.ca_state AS state, count(*) AS cnt
FROM customer_address a, customer c, store_sales s, date_dim d, item i
WHERE a.ca_address_sk = c.c_current_addr_sk
  AND c.c_customer_sk = s.ss_customer_sk
  AND s.ss_sold_date_sk = d.d_date_sk
  AND s.ss_item_sk = i.i_item_sk
  AND d.d_year = 2000
  AND i.i_current_price > 1.2 *
      (SELECT avg(j.i_current_price) FROM item j
       WHERE j.i_category = i.i_category)
GROUP BY a.ca_state HAVING count(*) >= 10
ORDER BY cnt, state LIMIT 100"""

# q36: gross-margin reporting over ROLLUP(category, class)
Q36 = """SELECT sum(ss_net_profit) / sum(ss_ext_sales_price)
    AS gross_margin, i_category, i_class
FROM store_sales, date_dim, item, store
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND ss_store_sk = s_store_sk AND d_year = 2001
  AND s_state IN ('CA', 'TX')
GROUP BY ROLLUP(i_category, i_class)
ORDER BY gross_margin, i_category, i_class LIMIT 100"""

# q98: per-item revenue as a ratio of its class total — a window
# aggregate over the grouped result
Q98 = """SELECT i_item_sk, i_class, itemrevenue,
    itemrevenue * 100.0 / sum(itemrevenue)
        OVER (PARTITION BY i_class) AS revenueratio
FROM (SELECT i_item_sk, i_class,
             sum(ss_ext_sales_price) AS itemrevenue
      FROM store_sales, item, date_dim
      WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
        AND i_category IN ('cat#1', 'cat#2', 'cat#3')
        AND d_year = 1999 AND d_moy = 2
      GROUP BY i_item_sk, i_class) t
ORDER BY i_class, revenueratio LIMIT 100"""

QUERIES = {"q3": Q3, "q6": Q6, "q19": Q19, "q36": Q36, "q42": Q42,
           "q52": Q52, "q55": Q55, "q98": Q98}
