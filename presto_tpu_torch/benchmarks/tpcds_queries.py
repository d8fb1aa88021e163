"""The repo's TPC-DS query bank as data, for the port's CPU tests and the
chip script's TPC-DS phase (benchmarks/tpcds_run.py).

- `QUERIES`: the 21 official-shaped queries of the conformance bank over
  the generated 24-table schema (texts with the standard validation
  substitutions, adapted to the generated column subset), run under
  `BANK_CONFIG`;
- `SHAPES`: the shape queries of the TPC-DS suite (Q3, Q42, the Q7-like
  promotion report, the fact-dimension join, mixed distinct, the
  returned-orders semi join, Q12's window ratio, Q51's cumulative
  windows), run under the default config; `ORDERED` names those whose
  order is part of the answer;
- `Q95` (BASELINE config 5), `q95(end, company)` its text with the
  window's end and the optional web_company_name filter: `Q95_OFFICIAL`
  the official 60-day window, `Q95_WIDE` the widened one whose answer
  is non-empty at sf0.01;
- the three Q95 cores over the ws_order_number co-bucket layout, and
  `DISTRIBUTED_Q3`, the distributed runner's Q3."""

# the bank's ExecutionConfig fields (the conformance suite's runner)
BANK_CONFIG = dict(batch_rows=1 << 14, join_out_capacity=1 << 16)


QUERIES = {
    "q03": """
        SELECT d_year, i_brand_id, i_brand,
               sum(ss_ext_sales_price) AS sum_agg
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manufact_id = 128 AND d_moy = 11
        GROUP BY d_year, i_brand_id, i_brand
        ORDER BY d_year, sum_agg DESC, i_brand_id
        LIMIT 100""",
    "q07": """
        SELECT i_item_id, avg(ss_quantity) AS agg1,
               avg(ss_list_price) AS agg2, avg(ss_coupon_amt) AS agg3,
               avg(ss_sales_price) AS agg4
        FROM store_sales, customer_demographics, date_dim, item, promotion
        WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
          AND ss_cdemo_sk = cd_demo_sk AND ss_promo_sk = p_promo_sk
          AND cd_gender = 'M' AND cd_marital_status = 'S'
          AND cd_education_status = 'College'
          AND (p_channel_email = 'N' OR p_channel_tv = 'N')
          AND d_year = 2000
        GROUP BY i_item_id ORDER BY i_item_id LIMIT 100""",
    "q19": """
        SELECT i_brand_id, i_brand, i_manufact_id,
               sum(ss_ext_sales_price) AS ext_price
        FROM date_dim, store_sales, item, customer, customer_address, store
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = 8 AND d_moy = 11 AND d_year = 1998
          AND ss_customer_sk = c_customer_sk
          AND c_current_addr_sk = ca_address_sk
          AND ss_store_sk = s_store_sk
          AND ca_state <> s_state
        GROUP BY i_brand_id, i_brand, i_manufact_id
        ORDER BY ext_price DESC, i_brand_id LIMIT 100""",
    "q26": """
        SELECT i_item_id, avg(cs_quantity) AS agg1,
               avg(cs_list_price) AS agg2, avg(cs_sales_price) AS agg3
        FROM catalog_sales, customer_demographics, date_dim, item
        WHERE cs_sold_date_sk = d_date_sk AND cs_item_sk = i_item_sk
          AND cs_bill_cdemo_sk = cd_demo_sk
          AND cd_gender = 'F' AND cd_marital_status = 'W'
          AND cd_education_status = 'Primary' AND d_year = 2000
        GROUP BY i_item_id ORDER BY i_item_id LIMIT 100""",
    "q37": """
        SELECT i_item_id, i_current_price, count(*) AS cnt
        FROM item, inventory, date_dim, catalog_sales
        WHERE i_current_price BETWEEN 20 AND 50
          AND inv_item_sk = i_item_sk
          AND d_date_sk = inv_date_sk AND d_year = 2000
          AND inv_quantity_on_hand BETWEEN 100 AND 500
          AND cs_item_sk = i_item_sk
        GROUP BY i_item_id, i_current_price
        ORDER BY i_item_id LIMIT 100""",
    "q43": """
        SELECT s_store_name, s_store_id,
               sum(CASE WHEN d_day_name = 'Sunday'
                        THEN ss_sales_price ELSE NULL END) AS sun_sales,
               sum(CASE WHEN d_day_name = 'Monday'
                        THEN ss_sales_price ELSE NULL END) AS mon_sales,
               sum(CASE WHEN d_day_name = 'Friday'
                        THEN ss_sales_price ELSE NULL END) AS fri_sales
        FROM date_dim, store_sales, store
        WHERE d_date_sk = ss_sold_date_sk AND s_store_sk = ss_store_sk
          AND d_year = 2000
        GROUP BY s_store_name, s_store_id
        ORDER BY s_store_name, s_store_id LIMIT 100""",
    "q52": """
        SELECT d_year, i_brand_id, i_brand,
               sum(ss_ext_sales_price) AS ext_price
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = 1 AND d_moy = 11 AND d_year = 2000
        GROUP BY d_year, i_brand_id, i_brand
        ORDER BY d_year, ext_price DESC, i_brand_id LIMIT 100""",
    "q55": """
        SELECT i_brand_id, i_brand, sum(ss_ext_sales_price) AS ext_price
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = 28 AND d_moy = 11 AND d_year = 1999
        GROUP BY i_brand_id, i_brand
        ORDER BY ext_price DESC, i_brand_id LIMIT 100""",
    "q62": """
        SELECT w_warehouse_name, sm_type, web_name,
               sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk <= 30
                        THEN 1 ELSE 0 END) AS d30,
               sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 30
                         AND ws_ship_date_sk - ws_sold_date_sk <= 60
                        THEN 1 ELSE 0 END) AS d60,
               sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 120
                        THEN 1 ELSE 0 END) AS dmore
        FROM web_sales, warehouse, ship_mode, web_site, date_dim
        WHERE d_month_seq BETWEEN 1200 AND 1211
          AND ws_ship_date_sk = d_date_sk
          AND ws_warehouse_sk = w_warehouse_sk
          AND ws_ship_mode_sk = sm_ship_mode_sk
          AND ws_web_site_sk = web_site_sk
        GROUP BY w_warehouse_name, sm_type, web_name
        ORDER BY w_warehouse_name, sm_type, web_name LIMIT 100""",
    "q65": """
        SELECT s_store_name, i_item_id, sb.revenue
        FROM store, item,
             (SELECT ss_store_sk AS store_sk, ss_item_sk AS item_sk,
                     sum(ss_sales_price) AS revenue
              FROM store_sales, date_dim
              WHERE ss_sold_date_sk = d_date_sk
                AND d_month_seq BETWEEN 1176 AND 1187
              GROUP BY ss_store_sk, ss_item_sk) sb
        WHERE sb.store_sk = s_store_sk AND sb.item_sk = i_item_sk
          AND sb.revenue > 490000
        ORDER BY s_store_name, i_item_id LIMIT 100""",
    "q82": """
        SELECT i_item_id, i_current_price, count(*) AS cnt
        FROM item, inventory, date_dim, store_sales
        WHERE i_current_price BETWEEN 30 AND 60
          AND inv_item_sk = i_item_sk
          AND d_date_sk = inv_date_sk AND d_year = 1999
          AND inv_quantity_on_hand BETWEEN 100 AND 500
          AND ss_item_sk = i_item_sk
        GROUP BY i_item_id, i_current_price
        ORDER BY i_item_id LIMIT 100""",
    "q84": """
        SELECT c_customer_id, c_last_name, c_first_name
        FROM customer, customer_address, customer_demographics,
             household_demographics, income_band, store_returns
        WHERE ca_city = 'Pleasant Hill'
          AND c_current_addr_sk = ca_address_sk
          AND ib_income_band_sk = hd_income_band_sk
          AND ib_lower_bound >= 30000 AND ib_upper_bound <= 70000
          AND cd_demo_sk = c_current_cdemo_sk
          AND hd_demo_sk = c_current_hdemo_sk
          AND sr_cdemo_sk = cd_demo_sk
        ORDER BY c_customer_id LIMIT 100""",
    "q89": """
        SELECT i_category, i_class, s_store_name, d_moy,
               sum(ss_sales_price) AS sum_sales,
               avg(sum(ss_sales_price)) OVER (
                   PARTITION BY i_category, i_class, s_store_name)
                   AS avg_monthly_sales
        FROM item, store_sales, date_dim, store
        WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
          AND ss_store_sk = s_store_sk AND d_year = 1999
          AND i_category IN ('Books', 'Electronics', 'Sports')
        GROUP BY i_category, i_class, s_store_name, d_moy
        ORDER BY i_category, i_class, s_store_name, d_moy LIMIT 100""",
    "q91": """
        SELECT cc_name, cc_manager, sum(cr_net_loss) AS net_loss
        FROM call_center, catalog_returns, date_dim, customer,
             customer_demographics, household_demographics
        WHERE cr_call_center_sk = cc_call_center_sk
          AND cr_returned_date_sk = d_date_sk
          AND cr_returning_customer_sk = c_customer_sk
          AND cd_demo_sk = c_current_cdemo_sk
          AND hd_demo_sk = c_current_hdemo_sk
          AND d_year = 1999 AND d_moy = 11
          AND cd_marital_status = 'M' AND cd_education_status = 'Unknown'
          AND hd_buy_potential LIKE 'Unknown%'
        GROUP BY cc_name, cc_manager
        ORDER BY net_loss DESC, cc_name""",
    "q96": """
        SELECT count(*) AS cnt
        FROM store_sales, household_demographics, time_dim, store
        WHERE ss_sold_time_sk = t_time_sk AND ss_hdemo_sk = hd_demo_sk
          AND ss_store_sk = s_store_sk
          AND t_hour = 20 AND t_minute >= 30 AND hd_dep_count = 7
          AND s_store_name = 'ese'""",
    "q98": """
        SELECT i_item_id, i_category, i_class, i_current_price,
               sum(ss_ext_sales_price) AS itemrevenue,
               sum(ss_ext_sales_price) * 100
                   / sum(sum(ss_ext_sales_price)) OVER
                     (PARTITION BY i_class) AS revenueratio
        FROM store_sales, item, date_dim
        WHERE ss_item_sk = i_item_sk
          AND i_category IN ('Sports', 'Books', 'Home')
          AND ss_sold_date_sk = d_date_sk
          AND d_date BETWEEN DATE '1999-02-22' AND DATE '1999-03-24'
        GROUP BY i_item_id, i_category, i_class, i_current_price
        ORDER BY i_category, i_class, i_item_id LIMIT 100""",
    "q99": """
        SELECT w_warehouse_name, sm_type, cc_name,
               sum(CASE WHEN cs_ship_date_sk - cs_sold_date_sk <= 30
                        THEN 1 ELSE 0 END) AS d30,
               sum(CASE WHEN cs_ship_date_sk - cs_sold_date_sk > 30
                         AND cs_ship_date_sk - cs_sold_date_sk <= 60
                        THEN 1 ELSE 0 END) AS d60,
               sum(CASE WHEN cs_ship_date_sk - cs_sold_date_sk > 120
                        THEN 1 ELSE 0 END) AS dmore
        FROM catalog_sales, warehouse, ship_mode, call_center, date_dim
        WHERE d_month_seq BETWEEN 1200 AND 1211
          AND cs_ship_date_sk = d_date_sk
          AND cs_warehouse_sk = w_warehouse_sk
          AND cs_ship_mode_sk = sm_ship_mode_sk
          AND cs_call_center_sk = cc_call_center_sk
        GROUP BY w_warehouse_name, sm_type, cc_name
        ORDER BY w_warehouse_name, sm_type, cc_name LIMIT 100""",
    "q25_shape": """
        SELECT i_item_id, i_item_sk, sum(ss_net_profit) AS store_profit,
               sum(sr_net_loss) AS return_loss
        FROM store_sales, store_returns, item
        WHERE ss_item_sk = i_item_sk AND sr_item_sk = i_item_sk
          AND ss_customer_sk = sr_customer_sk
          AND ss_ticket_number = sr_ticket_number
        GROUP BY i_item_id, i_item_sk
        ORDER BY i_item_id, i_item_sk LIMIT 100""",
    "q16_shape_exists": """
        SELECT count(DISTINCT cs_order_number) AS order_count,
               sum(cs_ext_ship_cost) AS total_ship
        FROM catalog_sales, date_dim, customer_address, call_center
        WHERE d_date >= DATE '2002-02-01' AND d_date < DATE '2002-04-01'
          AND cs_ship_date_sk = d_date_sk
          AND cs_ship_addr_sk = ca_address_sk AND ca_state = 'GA'
          AND cs_call_center_sk = cc_call_center_sk
          AND EXISTS (SELECT 1 FROM catalog_returns
                      WHERE cs_order_number = cr_order_number)""",
    "q42_full": """
        SELECT d_year, i_category_id, i_category,
               sum(ss_ext_sales_price) AS total
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = 1 AND d_moy = 11 AND d_year = 2000
        GROUP BY d_year, i_category_id, i_category
        ORDER BY total DESC, d_year, i_category_id LIMIT 100""",
    "q93_shape": """
        SELECT ss_customer_sk, sum(ss_sales_price) AS sumsales
        FROM store_sales
        JOIN store_returns ON ss_item_sk = sr_item_sk
                          AND ss_ticket_number = sr_ticket_number
        JOIN reason ON sr_reason_sk = r_reason_sk
        WHERE r_reason_desc = 'reason 28'
        GROUP BY ss_customer_sk
        ORDER BY sumsales DESC, ss_customer_sk LIMIT 100""",
}


SHAPES = {
    "q3_shape": """
        select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) sum_agg
        from date_dim, store_sales, item
        where d_date_sk = ss_sold_date_sk
          and ss_item_sk = i_item_sk
          and i_manufact_id = 128
          and d_moy = 11
        group by d_year, i_brand_id, i_brand
        order by d_year, sum_agg desc, i_brand_id
        limit 100""",
    "q42_shape": """
        select d_year, i_category_id, i_category, sum(ss_ext_sales_price)
        from date_dim, store_sales, item
        where d_date_sk = ss_sold_date_sk
          and ss_item_sk = i_item_sk
          and i_manager_id = 1
          and d_moy = 11 and d_year = 2000
        group by d_year, i_category_id, i_category
        order by 4 desc, d_year, i_category_id, i_category
        limit 100""",
    "q7_promo": """
        select i_category, avg(ss_quantity), avg(ss_list_price),
               avg(ss_sales_price)
        from store_sales, item, promotion
        where ss_item_sk = i_item_sk
          and ss_promo_sk = p_promo_sk
          and (p_channel_email = 'N' or p_channel_tv = 'N')
        group by i_category
        order by i_category""",
    "fact_dimension_join": """
        select ca_state, count(*)
        from web_sales, customer_address
        where ws_ship_addr_sk = ca_address_sk
        group by ca_state""",
    "returned_orders_semi": """
        select count(*) from web_sales
        where ws_order_number in (select wr_order_number from web_returns)""",
    "q12_window_ratio": """
        select i_item_id, i_category, i_class,
               sum(ws_ext_sales_price) as itemrevenue,
               sum(ws_ext_sales_price) * 100 /
                 sum(sum(ws_ext_sales_price)) over (partition by i_class)
                 as revenueratio
        from web_sales, item, date_dim
        where ws_item_sk = i_item_sk
          and i_category in ('Sports', 'Books', 'Men')
          and ws_sold_date_sk = d_date_sk
          and d_date between date '1999-02-22' and date '1999-06-22'
        group by i_item_id, i_category, i_class
        order by i_category, i_class, i_item_id, itemrevenue
        limit 100""",
    "q51_cumulative": """
        select ss_item_sk, d_date, sum(ss_ext_sales_price) day_sales,
               sum(sum(ss_ext_sales_price))
                   over (partition by ss_item_sk order by d_date) cume
        from store_sales, date_dim
        where ss_sold_date_sk = d_date_sk
          and d_date between date '2000-01-01' and date '2000-02-01'
          and ss_item_sk < 50
        group by ss_item_sk, d_date""",
    "mixed_distinct_global": """
        select count(distinct ws_web_site_sk), count(*), sum(ws_quantity),
               min(ws_sales_price)
        from web_sales where ws_order_number < 500""",
    "mixed_distinct_grouped": """
        select ws_web_site_sk, count(distinct ws_warehouse_sk), count(*)
        from web_sales group by ws_web_site_sk""",
}
ORDERED = frozenset({"q3_shape", "q42_shape", "q7_promo",
                     "q12_window_ratio"})

Q95 = """
with ws_wh as
 (select ws1.ws_order_number
  from web_sales ws1, web_sales ws2
  where ws1.ws_order_number = ws2.ws_order_number
    and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
select count(distinct ws_order_number),
       sum(ws_ext_ship_cost),
       sum(ws_net_profit)
from web_sales ws1, date_dim, customer_address, web_site
where d_date between date '1999-02-01' and date '{end}'
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk
  and ca_state = 'IL'
  and ws1.ws_web_site_sk = web_site_sk
  {company}
  and ws1.ws_order_number in (select ws_order_number from ws_wh)
  and ws1.ws_order_number in (select wr_order_number from web_returns, ws_wh
                              where wr_order_number = ws_wh.ws_order_number)
order by 1 limit 100
"""


def q95(end: str, company: bool) -> str:
    """Q95's text with its window ending at `end`, with or without the
    official web_company_name filter."""
    return Q95.format(end=end, company="and web_company_name = 'pri'"
                      if company else "")


# the official text (BASELINE config 5; empty at sf0.01) and the widened
# window whose intersection is non-empty
Q95_OFFICIAL = q95("1999-04-02", True)
Q95_WIDE = q95("2002-12-31", False)

Q95_SEMI_CORE = """
select ws_order_number, count(*) c, sum(ws_ext_ship_cost) s
from web_sales
where ws_order_number in (select wr_order_number from web_returns)
group by ws_order_number
order by ws_order_number
"""

Q95_JOIN_CORE = """
select ws_order_number, sum(wr_return_amt) amt
from web_sales join web_returns on ws_order_number = wr_order_number
group by ws_order_number
order by ws_order_number
"""

Q95_SELF_JOIN_CORE = """
select ws1.ws_order_number, count(*) c
from web_sales ws1 join web_sales ws2
  on ws1.ws_order_number = ws2.ws_order_number
where ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk
group by ws1.ws_order_number
order by ws1.ws_order_number
"""

CORES = {"semi": Q95_SEMI_CORE, "join": Q95_JOIN_CORE,
         "self_join": Q95_SELF_JOIN_CORE}

DISTRIBUTED_Q3 = """
        select d_year, i_brand_id, sum(ss_ext_sales_price)
        from date_dim, store_sales, item
        where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
          and d_moy = 11
        group by d_year, i_brand_id"""


def bank() -> dict:
    """Every query of the bank: name -> (sql, config, ordered), where
    `config` is "bank" (the conformance bank's `BANK_CONFIG`) or
    "default" (the runner's default config, as the shape suite runs)."""
    out = {name: (sql, "bank", False) for name, sql in QUERIES.items()}
    out.update({name: (sql, "default", name in ORDERED)
                for name, sql in SHAPES.items()})
    out["q95_official"] = (Q95_OFFICIAL, "default", False)
    out["q95_wide"] = (Q95_WIDE, "default", False)
    out.update({f"core_{k}": (sql, "default", True)
                for k, sql in CORES.items()})
    return out
